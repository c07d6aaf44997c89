"""Distribution tier of the port: the single-device shuffle write
(``shuffle.hash_partition``). The mesh and the TCP exchange are not
ported yet."""
