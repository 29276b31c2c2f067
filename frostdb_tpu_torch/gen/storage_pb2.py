# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: frostdb_tpu/v1/storage.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1c\x66rostdb_tpu/v1/storage.proto\x12\x0e\x66rostdb_tpu.v1\"H\n\x0cQueryRequest\x12&\n\x04plan\x18\x01 \x01(\x0b\x32\x18.frostdb_tpu.v1.PlanNode\x12\x10\n\x08\x64\x61tabase\x18\x02 \x01(\t\"\x1f\n\rQueryResponse\x12\x0e\n\x06record\x18\x01 \x01(\x0c\"\xd7\x03\n\x08PlanNode\x12&\n\x04next\x18\x01 \x01(\x0b\x32\x18.frostdb_tpu.v1.PlanNode\x12/\n\ntable_scan\x18\x02 \x01(\x0b\x32\x19.frostdb_tpu.v1.TableScanH\x00\x12\x31\n\x0bschema_scan\x18\x03 \x01(\x0b\x32\x1a.frostdb_tpu.v1.SchemaScanH\x00\x12(\n\x06\x66ilter\x18\x04 \x01(\x0b\x32\x16.frostdb_tpu.v1.FilterH\x00\x12\x30\n\nprojection\x18\x05 \x01(\x0b\x32\x1a.frostdb_tpu.v1.ProjectionH\x00\x12,\n\x08\x64istinct\x18\x06 \x01(\x0b\x32\x18.frostdb_tpu.v1.DistinctH\x00\x12\x32\n\x0b\x61ggregation\x18\x07 \x01(\x0b\x32\x1b.frostdb_tpu.v1.AggregationH\x00\x12&\n\x05limit\x18\x08 \x01(\x0b\x32\x15.frostdb_tpu.v1.LimitH\x00\x12$\n\x04join\x18\t \x01(\x0b\x32\x14.frostdb_tpu.v1.JoinH\x00\x12+\n\x08order_by\x18\n \x01(\x0b\x32\x17.frostdb_tpu.v1.OrderByH\x00\x42\x06\n\x04spec\"^\n\x07OrderBy\x12)\n\x04keys\x18\x01 \x03(\x0b\x32\x1b.frostdb_tpu.v1.OrderBy.Key\x1a(\n\x03Key\x12\x0e\n\x06\x63olumn\x18\x01 \x01(\t\x12\x11\n\tdirection\x18\x02 \x01(\t\"H\n\x04Join\x12\'\n\x05right\x18\x01 \x01(\x0b\x32\x18.frostdb_tpu.v1.PlanNode\x12\n\n\x02on\x18\x02 \x03(\t\x12\x0b\n\x03how\x18\x03 \x01(\t\"\x1f\n\tTableScan\x12\x12\n\ntable_name\x18\x01 \x01(\t\" \n\nSchemaScan\x12\x12\n\ntable_name\x18\x01 \x01(\t\",\n\x06\x46ilter\x12\"\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\"1\n\nProjection\x12#\n\x05\x65xprs\x18\x01 \x03(\x0b\x32\x14.frostdb_tpu.v1.Expr\"/\n\x08\x44istinct\x12#\n\x05\x65xprs\x18\x01 \x03(\x0b\x32\x14.frostdb_tpu.v1.Expr\"a\n\x0b\x41ggregation\x12)\n\x0bgroup_exprs\x18\x01 \x03(\x0b\x32\x14.frostdb_tpu.v1.Expr\x12\'\n\tagg_exprs\x18\x02 \x03(\x0b\x32\x14.frostdb_tpu.v1.Expr\"+\n\x05Limit\x12\"\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\"\xd8\x03\n\x04\x45xpr\x12(\n\x06\x63olumn\x18\x01 \x01(\x0b\x32\x16.frostdb_tpu.v1.ColumnH\x00\x12\x37\n\x0e\x64ynamic_column\x18\x02 \x01(\x0b\x32\x1d.frostdb_tpu.v1.DynamicColumnH\x00\x12*\n\x07literal\x18\x03 \x01(\x0b\x32\x17.frostdb_tpu.v1.LiteralH\x00\x12,\n\x06\x62inary\x18\x04 \x01(\x0b\x32\x1a.frostdb_tpu.v1.BinaryExprH\x00\x12:\n\x0b\x61ggregation\x18\x05 \x01(\x0b\x32#.frostdb_tpu.v1.AggregationFunctionH\x00\x12&\n\x05\x61lias\x18\x06 \x01(\x0b\x32\x15.frostdb_tpu.v1.AliasH\x00\x12*\n\x07\x63onvert\x18\x07 \x01(\x0b\x32\x17.frostdb_tpu.v1.ConvertH\x00\x12)\n\x07is_null\x18\x08 \x01(\x0b\x32\x16.frostdb_tpu.v1.IsNullH\x00\x12,\n\x08\x64uration\x18\t \x01(\x0b\x32\x18.frostdb_tpu.v1.DurationH\x00\x12\"\n\x03\x61ll\x18\n \x01(\x0b\x32\x13.frostdb_tpu.v1.AllH\x00\x42\x06\n\x04kind\"\x16\n\x06\x43olumn\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1d\n\rDynamicColumn\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x97\x01\n\x07Literal\x12\x0e\n\x04null\x18\x01 \x01(\x08H\x00\x12\x15\n\x0bint64_value\x18\x02 \x01(\x03H\x00\x12\x16\n\x0cuint64_value\x18\x03 \x01(\x04H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x12\x16\n\x0cstring_value\x18\x05 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x06 \x01(\x08H\x00\x42\x07\n\x05value\"a\n\nBinaryExpr\x12\"\n\x04left\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\x12\n\n\x02op\x18\x02 \x01(\t\x12#\n\x05right\x18\x03 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\"G\n\x13\x41ggregationFunction\x12\x0c\n\x04\x66unc\x18\x01 \x01(\t\x12\"\n\x04\x65xpr\x18\x02 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\"9\n\x05\x41lias\x12\"\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\x12\x0c\n\x04name\x18\x02 \x01(\t\">\n\x07\x43onvert\x12\"\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\x12\x0f\n\x07to_type\x18\x02 \x01(\t\",\n\x06IsNull\x12\"\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x14.frostdb_tpu.v1.Expr\" \n\x08\x44uration\x12\x14\n\x0cmilliseconds\x18\x01 \x01(\x03\"\x05\n\x03\x41ll2]\n\x11\x46rostDBTPUService\x12H\n\x05Query\x12\x1c.frostdb_tpu.v1.QueryRequest\x1a\x1d.frostdb_tpu.v1.QueryResponse\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'frostdb_tpu.v1.storage_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _QUERYREQUEST._serialized_start=48
  _QUERYREQUEST._serialized_end=120
  _QUERYRESPONSE._serialized_start=122
  _QUERYRESPONSE._serialized_end=153
  _PLANNODE._serialized_start=156
  _PLANNODE._serialized_end=627
  _ORDERBY._serialized_start=629
  _ORDERBY._serialized_end=723
  _ORDERBY_KEY._serialized_start=683
  _ORDERBY_KEY._serialized_end=723
  _JOIN._serialized_start=725
  _JOIN._serialized_end=797
  _TABLESCAN._serialized_start=799
  _TABLESCAN._serialized_end=830
  _SCHEMASCAN._serialized_start=832
  _SCHEMASCAN._serialized_end=864
  _FILTER._serialized_start=866
  _FILTER._serialized_end=910
  _PROJECTION._serialized_start=912
  _PROJECTION._serialized_end=961
  _DISTINCT._serialized_start=963
  _DISTINCT._serialized_end=1010
  _AGGREGATION._serialized_start=1012
  _AGGREGATION._serialized_end=1109
  _LIMIT._serialized_start=1111
  _LIMIT._serialized_end=1154
  _EXPR._serialized_start=1157
  _EXPR._serialized_end=1629
  _COLUMN._serialized_start=1631
  _COLUMN._serialized_end=1653
  _DYNAMICCOLUMN._serialized_start=1655
  _DYNAMICCOLUMN._serialized_end=1684
  _LITERAL._serialized_start=1687
  _LITERAL._serialized_end=1838
  _BINARYEXPR._serialized_start=1840
  _BINARYEXPR._serialized_end=1937
  _AGGREGATIONFUNCTION._serialized_start=1939
  _AGGREGATIONFUNCTION._serialized_end=2010
  _ALIAS._serialized_start=2012
  _ALIAS._serialized_end=2069
  _CONVERT._serialized_start=2071
  _CONVERT._serialized_end=2133
  _ISNULL._serialized_start=2135
  _ISNULL._serialized_end=2179
  _DURATION._serialized_start=2181
  _DURATION._serialized_end=2213
  _ALL._serialized_start=2215
  _ALL._serialized_end=2220
  _FROSTDBTPUSERVICE._serialized_start=2222
  _FROSTDBTPUSERVICE._serialized_end=2315
# @@protoc_insertion_point(module_scope)
