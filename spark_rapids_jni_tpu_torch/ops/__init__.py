"""Operators of the port: uword helpers, byte relayouts, the JCUDF row
transcode, the bounded group-by and their hand-written kernels."""
