"""Multi-rank data parallelism: the process group, the gradient ring and
its wire compression, and ZeRO-1's sharded update (counterpart of
``tpu_ddp/parallel``)."""
