"""Operators of the port: uword helpers, byte relayouts, the JCUDF row
transcode, the bounded and the sort-based group-by, the exact FLOAT64
accumulator, expressions, Murmur3 hashing, sort, gather and the
equi-join, and their hand-written kernels."""
