from .pipeline import DataConfig, MemmapSource, Prefetcher, SyntheticLM
from .placement import FetchAssignment, ShardMeta, plan_epoch, prefetch_epoch, uniform_shards
