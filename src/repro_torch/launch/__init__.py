# Launch layer: the serving and training entry points (``python -m
# repro_torch.launch.serve``, ``python -m repro_torch.launch.train``). The
# multi-pod dry run, meshes, input specs, roofline analysis and sharded
# training are ROADMAP Queue 1 item 12.
