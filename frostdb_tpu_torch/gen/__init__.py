"""Generated protobuf code (protoc --python_out from proto/frostdb_tpu/v1)."""
