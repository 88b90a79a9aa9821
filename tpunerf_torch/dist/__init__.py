"""Multi-rank training: the (data, rays) device mesh over torch.distributed
(`dist/mesh.py`)."""
