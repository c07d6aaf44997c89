"""Distribution tier of the port: the single-device shuffle write
(``shuffle.hash_partition``) and the in-mesh tier, one controller over a
mesh of devices (``mesh``, ``device``, the all-to-all exchange in
``shuffle``, ``distributed``, ``join_distributed``, ``sort_distributed``
and ``table_ops``). The cross-process TCP exchange is not ported yet."""
