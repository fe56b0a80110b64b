"""repro_torch.launch -- serving entry points of the port.

Only the streaming path-query server (:mod:`.serve`) is ported; the
training and dry-run launchers come with later slices.
"""
