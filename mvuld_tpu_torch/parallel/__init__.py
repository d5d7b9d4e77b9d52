"""The parallel layer (counterpart of ``mvuld_tpu/parallel``): process-group
start-up (``distributed``), the (dp, mp) grid of ranks with data and tensor
parallelism (``mesh``), the GPipe text-encoder pipeline (``pipeline``) and
every collective the port issues (``collectives``)."""
