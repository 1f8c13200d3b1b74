"""Multi-device training over ``torch.distributed`` (counterpart of
``streetunveiler_tpu.parallel``): ``multihost.py`` (bootstrap, the one-host
launcher, each rank's batch), ``shard.py`` (the mesh and the sharded
step) and ``dryrun.py`` (one sharded step on an n-rank mesh)."""
