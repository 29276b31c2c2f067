"""Inspection CLIs (reference: cmd/parquet-tool, cmd/parquet-reencode)."""
