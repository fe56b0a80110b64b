"""repro_torch.launch -- entry points of the port: the streaming
path-query server (:mod:`.serve`), the step bundles (:mod:`.steps`), the
training driver CLI (:mod:`.train`), and the dry-run launchers: named
layouts (:mod:`.mesh`), the dry run on ``meta`` (:mod:`.dryrun`), its op
census (:mod:`.op_analysis`) and roofline (:mod:`.roofline`)."""
