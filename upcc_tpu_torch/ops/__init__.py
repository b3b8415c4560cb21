"""Key arithmetic, sparse sets, family convs and top-k (kernels K1-K3)."""
