# Building blocks for repro_torch.search (arena, tree, uct, stages, domains).
