"""repro_torch: the volunteer-computing swarm of `repro`, and the model
stack whose checkpoints it ships, on PyTorch and CUDA for an NVIDIA H100.

A port of the JAX package `repro` (Soelistio 2015: P2P torrent-like
application distribution in a volunteer-computing environment) that
mirrors its module tree and never imports jax.  Its hot paths are the
batched flash-crowd loop (`scenarios.scenario_vii` / `scenario_ix` ->
`core.runtime.SimRuntime.run_batched` -> `core.swarm_arrays.SwarmHub.tick`
-> `core.swarm_kernels`) and the serve path of the models
(`training.train_state.make_prefill_step` / `make_decode_step`,
`serving.engine.ServingEngine` -> `models.model` -> `models.ssm` /
`models.attention` -> `kernels.ssd` / `kernels.flash_attention`), and
training (`training.trainer.Trainer` -> `training.train_state.make_train_step`
-> `models.model.loss_fn`, the kernels under autograd) with the checkpoints
the swarm ships (`checkpoint`, `serving.engine.ServingEngine.from_swarm`).
All five kernels are hand-written CUDA for Hopper in `csrc/`.  Entry points take
`device=` ("cuda" by default, "cpu" for the plain PyTorch versions).
"""
__version__ = "0.2.0"
