"""svox_t_tpu — sparse voxel octree framework for dynamic
differentiable volume rendering.

A from-scratch JAX/XLA rebuild with the full capabilities of the
reference `svox_t` library (the renderer behind *Artemis: Articulated
Neural Pets*, TOG 2022): an N^3-branching sparse voxel octree whose leaf
contents index a per-frame feature pool, differentiable per-ray and
perspective volume rendering with SH/SG/ASG appearance, opacity / depth /
first-hit motion / LBS motion-feature passes, LBS vertex warping,
real-time octree (re)pointing, and point-to-voxel splatting — scaled over
GPUs via ray-sharded `pjit` (see `svox_t_tpu.parallel`).

Public API parity: reference `svox_t/__init__.py:30-35`.
"""

from .version import __version__

from .models.tree import N3Tree, WeightAccumulator
from .models.view import N3TreeView
from .models.renderer import VolumeRenderer, convert_to_ndc
from .utils.spec import (NDCConfig, Rays, RenderOptions, TreeSpec,
                         CameraSpec, DATA_SENTINEL, make_tree_spec)
from .utils.dataformat import DataFormat, LocalIndex
from .ops.warp import (blend_transformation_matrix, get_transformation_matrix,
                       warp_vertices)
from .ops.p2v import voxelize
from .ops.grid import grid_weight_render
from .ops.sh import eval_sh, eval_sh_bases
from .ops.render import QuantizedFeatures, quantize_features
from .ops.tape import (RayTape, pack_index_table, record_tape,
                       replay_depth, replay_render, replay_render_frames)
from .ops.tape_subset import (TapeRowSource, replay_render_rows,
                              subset_tape, train_minibatches,
                              train_steps)
from .utils.builders import tree_from_occupancy, tree_structure_from_occupancy

__all__ = [
    "N3Tree",
    "N3TreeView",
    "VolumeRenderer",
    "NDCConfig",
    "Rays",
    "RenderOptions",
    "TreeSpec",
    "CameraSpec",
    "DataFormat",
    "LocalIndex",
    "WeightAccumulator",
    "voxelize",
    "get_transformation_matrix",
    "warp_vertices",
    "blend_transformation_matrix",
    "grid_weight_render",
    "convert_to_ndc",
    "eval_sh",
    "tree_from_occupancy",
    "tree_structure_from_occupancy",
    "eval_sh_bases",
    "QuantizedFeatures",
    "quantize_features",
    "RayTape",
    "record_tape",
    "replay_render",
    "replay_render_frames",
    "replay_depth",
    "pack_index_table",
    "TapeRowSource",
    "subset_tape",
    "replay_render_rows",
    "train_minibatches",
    "train_steps",
    "make_tree_spec",
    "DATA_SENTINEL",
    "__version__",
]
