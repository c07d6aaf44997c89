"""Distribution tier of the port: the single-device shuffle write
(``shuffle.hash_partition``), the in-mesh tier, one controller over a
mesh of devices (``mesh``, ``device``, the all-to-all exchange in
``shuffle``, ``distributed``, ``join_distributed``, ``sort_distributed``
and ``table_ops``), and the cross-process tier: ``shuffle.TcpExchange``
with its worker harness, and ``cluster.ClusterView`` (imported by name,
as ``spark_rapids_jni_tpu_torch.parallel.cluster``)."""
