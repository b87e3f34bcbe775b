# Launch layer: the serving and training entry points (``python -m
# repro_torch.launch.serve``, ``python -m repro_torch.launch.train``, the
# latter also sharded over a mesh) and the meshes over a torch.distributed
# group (``mesh``). The multi-pod dry run, input specs and roofline
# analysis are ROADMAP Queue 1 item 12.
from .mesh import Mesh, init_distributed, make_production_mesh, make_test_mesh

__all__ = ["Mesh", "init_distributed", "make_production_mesh",
           "make_test_mesh"]
