"""Operators of the port: uword helpers, byte relayouts, the JCUDF row
transcode, the bounded group-by, Murmur3 hashing, sort, gather and the
equi-join, and their hand-written kernels."""
