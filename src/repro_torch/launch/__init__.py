"""Step factories and the train / serve drivers — the counterpart of
``repro.launch``; its meshes are ``repro_torch.parallel.make_mesh`` /
``make_host_mesh``, and its dry-run, HLO and roofline tools are not
ported."""
