"""The renderer's hand-written CUDA kernels by layer, as the device trace
names them (``__global__`` functions of ``optix_renderer_tpu_torch/csrc/``),
frozen when the benchmark was defined.  A name matches an operation when
it appears in the operation's name as a whole identifier
(``closest_kernel`` does not match ``closest_walk_kernel``).  Every other
kernel is PyTorch's: the glue."""

from __future__ import annotations

import re

# closest-hit and occlusion queries: B1, B2 (brute tier); B3, B4 in walk and list form, the walk
# over baked rows (B3-baked, closest_walk_kernel<..., BakedTri>) (cluster tier)
TRACE_QUERIES = ("closest_kernel", "any_kernel", "closest_walk_kernel", "any_walk_kernel",
                 "closest_cluster_kernel", "any_cluster_kernel")
# the trace layer: the queries and the cluster tier's winner attribute fetch B5
TRACE = TRACE_QUERIES + ("winner_attr_kernel",)
# the path bounce K1, K2 and the brute tier's shade gather K3
BOUNCE = ("path_sample_kernel", "path_combine_kernel", "brute_shade_kernel")
# the LTC term B6
LTC = ("ltc_kernel",)
HAND = TRACE + BOUNCE + LTC
# device operations that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")

_patterns = {name: re.compile(r"(?<![A-Za-z0-9_])" + name + r"(?![A-Za-z0-9_])") for name in HAND}


def matches(op_name: str, names) -> bool:
    return any(_patterns[n].search(op_name) for n in names)


def is_kernel(op_name: str) -> bool:
    return not op_name.startswith(NOT_KERNELS)
