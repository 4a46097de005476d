"""Node-keyed sketch state and its one EMA update (counterpart of
``repro.sketches``)."""
from repro_torch.sketches.node import SketchNode, init_paper_node
from repro_torch.sketches.tree import (
    NodeSpec, NodeTree, gaussian_projections, init_node_tree, node_paths,
)
from repro_torch.sketches.update import (
    active_mask, ema_triple_update, mask_columns, proj_triple_update,
)

__all__ = [
    "NodeSpec", "NodeTree", "SketchNode", "active_mask",
    "ema_triple_update", "gaussian_projections", "init_node_tree",
    "init_paper_node", "mask_columns", "node_paths", "proj_triple_update",
]
