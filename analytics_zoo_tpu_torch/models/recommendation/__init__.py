"""The recommendation family (counterpart of
analytics_zoo_tpu/models/recommendation/, the same names): NeuralCF,
WideAndDeep and SessionRecommender, the ranking mixin and the feature
utilities.  Importing it needs no pandas."""

from analytics_zoo_tpu_torch.models.recommendation.ncf import NeuralCF  # noqa: F401,E501
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (  # noqa: F401,E501
    ColumnFeatureInfo,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.recommendation.session_recommender import (  # noqa: F401,E501
    SessionRecommender,
)
from analytics_zoo_tpu_torch.models.recommendation.recommender import (  # noqa: F401,E501
    Recommender,
)
from analytics_zoo_tpu_torch.models.recommendation.utils import (  # noqa: F401
    UserItemFeature,
    UserItemPrediction,
    categorical_from_vocab_list,
    get_boundaries,
    get_deep_tensors,
    get_negative_samples,
    get_wide_indices,
    hash_bucket,
    row_to_sample,
    rows_to_features,
    to_user_item_feature,
)
