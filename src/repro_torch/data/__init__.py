from repro_torch.data.partition import (  # noqa: F401
    PARTITION_KINDS, PopulationPartition, label_bias, label_shard_assignment,
    make_partition, partition_dirichlet, partition_iid,
    partition_label_shards, population_label_bias, population_partition,
)
from repro_torch.data.synthetic import (  # noqa: F401
    TokenStream, federated_split, make_classification,
)
