"""The port of ``elasticdl_tpu/preprocessing``: the transforms
(``layers``) and the feature-column glue over them
(``feature_column``)."""

from elasticdl_tpu_torch.preprocessing.layers import (  # noqa: F401
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    Normalizer,
    RoundIdentity,
    to_padded_ids,
)
from elasticdl_tpu_torch.preprocessing.feature_column import (  # noqa: F401
    FeatureLayer,
    bucketized_column,
    categorical_column_with_hash_bucket,
    categorical_column_with_identity,
    categorical_column_with_vocabulary_list,
    crossed_column,
    embedding_column,
    numeric_column,
    shared_embedding_columns,
)
