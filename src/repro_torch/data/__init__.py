from repro_torch.data.partition import (  # noqa: F401
    PARTITION_KINDS, label_shard_assignment, make_partition,
    partition_dirichlet, partition_iid, partition_label_shards,
)
from repro_torch.data.synthetic import federated_split, make_classification  # noqa: F401
