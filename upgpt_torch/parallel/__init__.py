"""Data and tensor parallelism: the port's `upgpt_tpu.parallel`.

`multihost` joins the processes of a run into one process group (the
backend chosen before the group starts) and gates the side effects on
rank 0; `mesh` takes a rank's rows of a global batch and averages
gradients and metrics over the group. The gradient exchange of a train
step is `DistributedDataParallel` over the training loss
(`upgpt_torch.training.train_state.data_parallel`).

`tp` splits the U-Net's transformers over in-process shards, Megatron's
column/row way, on a (data x model) grid of devices (a device may
repeat): JAX's `parallel/tp.py` spec table, the grid's float32
all-reduce and all-gather, and `TPLatentDiffusion`, which
`GenerationPipeline`, `training_loss` and `cli sample` / `test --tp N`
take as they take an unsharded model.
"""
