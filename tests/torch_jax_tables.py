"""The JAX package's trace tables as a port ``BVH``.

On the cluster tier the port's build orders the triangles by a top-down
median split and the JAX package's by Morton runs, so their cluster boxes
and packed keys differ.  A test that holds a port kernel or plain version
to the JAX package's gives both the same tables: these.
"""

import numpy as np

from optix_renderer_tpu_torch.accel import build as tbuild


def jax_tables(jbvh, device="cpu") -> tbuild.BVH:
    """``bvh_from_numpy`` of a JAX ``BVH``'s build products (its grouped
    cluster table regrouped flat, its shade rows carried as they are)."""
    arrs = {k: np.asarray(getattr(jbvh, k)) for k in ("tri_tab", "tri_v0", "tri_e1", "tri_e2", "prim_id",
                                                       "cluster_min", "cluster_max")}
    arrs["shade_a"], arrs["shade_b"] = (np.asarray(a) for a in jbvh.shade_tab)
    return tbuild.bvh_from_numpy(arrs, device)
