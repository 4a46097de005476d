"""Count-sketch gradient compression (counterpart of ``repro.countsketch``):
a linear sketch, so sketches of per-worker vectors add exactly."""
from repro_torch.countsketch.csvec import (
    CSVec, hash_buckets, hash_signs, insert, insert_at, make_csvec, merge,
    query, query_all, table_bytes, topk_streaming, unsketch, zero_table,
)

__all__ = [
    "CSVec", "hash_buckets", "hash_signs", "insert", "insert_at",
    "make_csvec", "merge", "query", "query_all", "table_bytes",
    "topk_streaming", "unsketch", "zero_table",
]
