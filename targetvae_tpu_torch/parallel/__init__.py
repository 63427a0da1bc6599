"""Multi-rank training over torch.distributed (mirror of
targetvae_tpu/parallel/): process-group set-up from arguments or from
torchrun's environment and a host-local launcher (distributed.py), the
(data, model) rank layout (mesh.py) and the grid-sharded,
sequence-parallel posterior (grid_softmax.py)."""
