"""Host utilities of the port: the error taxonomy the data plane raises
(``errors``) and the CRC contract of its frames (``integrity``)."""
