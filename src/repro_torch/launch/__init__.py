# Launch layer: the serving and training entry points (``python -m
# repro_torch.launch.serve``, ``python -m repro_torch.launch.train``, the
# latter also sharded over a mesh), the meshes over a torch.distributed
# group (``mesh``), the input specs on meta tensors (``specs``), the step
# counter (``counting``), the roofline on the H100's peaks (``roofline``)
# and the multi-pod dry run (``python -m repro_torch.launch.dryrun``).
# NOTE: dryrun is not imported here, as in the reference (whose dryrun
# sets XLA_FLAGS when imported); import it by name.
from .mesh import Mesh, init_distributed, make_production_mesh, make_test_mesh
from .roofline import (HBM_BW, LINK_BW, PEAK_FLOPS, RooflineTerms,
                       collective_bytes, model_flops_estimate, roofline)

__all__ = ["Mesh", "init_distributed", "make_production_mesh",
           "make_test_mesh", "collective_bytes", "roofline", "RooflineTerms",
           "model_flops_estimate", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]
