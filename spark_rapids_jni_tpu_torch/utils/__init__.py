"""Host utilities of the port: the error taxonomy (``errors``), the CRC
contract of its frames and exchanges (``integrity``) and the device-memory
budget (``memory``)."""
