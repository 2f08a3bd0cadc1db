"""Multi-rank data parallelism: the process group, the gradient ring and
its wire compression (counterpart of ``tpu_ddp/parallel``)."""
