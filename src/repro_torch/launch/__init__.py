"""Step factories and the train / serve drivers — the counterpart of
``repro.launch`` (its mesh, dry-run and roofline tools are not ported)."""
