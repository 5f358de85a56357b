"""Sharding rules (``repro/sharding``): logical axes to mesh axes, the
parameters' partition specs and the campaign grid's specs."""

from repro_torch.sharding.ctx import (NamedSharding, PartitionSpec,
                                      annotate, current_rules,
                                      dispatch_shards, lm_rules, spec_for,
                                      use_rules)

__all__ = ["NamedSharding", "PartitionSpec", "annotate", "current_rules",
           "dispatch_shards", "lm_rules", "spec_for", "use_rules"]
