"""repro_torch.ann — IVF index, k-means, PQ and the batched scan engine."""
