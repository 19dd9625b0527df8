"""Data parallelism on torch.distributed: the port's `upgpt_tpu.parallel`.

`multihost` joins the processes of a run into one process group (the
backend chosen before the group starts) and gates the side effects on
rank 0; `mesh` takes a rank's rows of a global batch and averages
gradients and metrics over the group. The gradient exchange of a train
step is `DistributedDataParallel` over the training loss
(`upgpt_torch.training.train_state.data_parallel`).
"""
