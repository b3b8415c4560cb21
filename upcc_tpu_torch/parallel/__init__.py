"""Multi-device paths of the port over ``torch.distributed`` and worker
threads: multi-process set-up (``multihost``), data-parallel training
(``data_parallel``), 2-D data x model training (``model_parallel``),
block-parallel inference (``block_parallel``) and a CPU dry run of the
data-parallel step (``dryrun``)."""
