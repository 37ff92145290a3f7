def search(cfg):
    return cfg.L, cfg.hops_bound
