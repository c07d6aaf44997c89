"""Host utilities of the port: the error taxonomy (``errors``), the CRC
contract of its frames and exchanges (``integrity``), the device-memory
budget (``memory``), and the runtime core around every public op: the
knob registry (``knobs``), metrics (``metrics``), deadlines and the
circuit breaker (``deadline``), tracing and the flight recorder
(``tracing``, ``trace_sink``), fault injection (``faultinj``), the retry
orchestrator (``retry``) and the op boundary itself (``dispatch``)."""
