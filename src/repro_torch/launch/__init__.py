# Launch layer: the serving entry point (``python -m
# repro_torch.launch.serve``). The multi-pod dry run, meshes, input specs,
# roofline analysis and the training entry point are ROADMAP Queue 1
# item 12.
