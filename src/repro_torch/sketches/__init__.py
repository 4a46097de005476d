"""Node-keyed sketch state and its one EMA update (counterpart of
``repro.sketches``). ``sketched_matmul`` lives in ``sketches.linear``."""
from repro_torch.sketches.node import (
    SketchNode, init_paper_node, zero_node_sketches,
)
from repro_torch.sketches.psparse import (
    PsparseProjections, init_psparse_projections, is_psparse,
    refresh_psparse_projections,
)
from repro_torch.sketches.tree import (
    NodeSpec, NodeTree, gaussian_projections, init_node_tree, node_paths,
    proj_to, refresh_tree, tree_memory_bytes, tree_to, zero_sketches,
)
from repro_torch.sketches.update import (
    active_mask, ema_apply_increment, ema_triple_increment,
    ema_triple_update, limit_rows, mask_columns, pad_activation_rows,
    proj_num_tokens, proj_triple_increment, proj_triple_update,
)

__all__ = [
    "NodeSpec", "NodeTree", "PsparseProjections", "SketchNode",
    "active_mask", "ema_apply_increment", "ema_triple_increment",
    "ema_triple_update", "gaussian_projections", "init_node_tree",
    "init_paper_node", "init_psparse_projections", "is_psparse",
    "limit_rows", "mask_columns", "node_paths", "pad_activation_rows",
    "proj_num_tokens", "proj_to", "proj_triple_increment",
    "proj_triple_update",
    "refresh_psparse_projections", "refresh_tree", "tree_memory_bytes",
    "tree_to", "zero_node_sketches", "zero_sketches",
]
