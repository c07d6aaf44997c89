"""Host-side IO tier of the port: the parquet footer service (host code,
like the reference's NativeParquetJni.cpp), the native codecs, and the
parquet / ORC data decode feeding device columns."""
