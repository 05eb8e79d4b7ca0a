"""Sharded transforms on torch.distributed: the port of `watfft_tpu/parallel/`.

`sharded` (batch, real batch and 2D faces, `make_mesh`), `large_sharded`
(one large FFT over the mesh), `real_sharded` (large real, 2D real and
STFT faces) and `dryrun` (every face once, and the multi-process launcher
the CPU tests and `chip_smoke.py` use). Every rank calls a face with its
own shard and gets its own output shard; the local transforms are the
port's kernels, the exchanges NCCL (gloo for CPU meshes) collectives.
"""
