"""repro_torch.launch -- entry points of the port: the streaming
path-query server (:mod:`.serve`), the LM step builder (:mod:`.steps`)
and the training driver CLI (:mod:`.train`). The dry-run launchers come
with a later slice."""
