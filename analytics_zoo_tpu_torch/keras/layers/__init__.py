"""The Keras layer vocabulary of the port (counterpart of
analytics_zoo_tpu/keras/layers/__init__.py): the same classes and
functions under the same names."""

from analytics_zoo_tpu_torch.keras.layers.core import (  # noqa: F401
    Activation,
    Dense,
    Dropout,
    Flatten,
    GaussianNoise,
    Highway,
    Lambda,
    Permute,
    SparseDense,
    RepeatVector,
    Reshape,
)
from analytics_zoo_tpu_torch.keras.layers.embeddings import (  # noqa: F401
    Embedding,
    SparseEmbedding,
)
from analytics_zoo_tpu_torch.keras.layers.normalization import (  # noqa: F401
    LRN2D,
    BatchNormalization,
    LayerNormalization,
    WithinChannelLRN2D,
)
from analytics_zoo_tpu_torch.keras.layers.conv import (  # noqa: F401
    AtrousConvolution1D,
    AtrousConvolution2D,
    Conv1D,
    Conv2D,
    Conv3D,
    Convolution1D,
    Convolution2D,
    Convolution3D,
    Cropping2D,
    Deconvolution2D,
    SeparableConv2D,
    ShareConvolution2D,
    UpSampling1D,
    UpSampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from analytics_zoo_tpu_torch.keras.layers.pooling import (  # noqa: F401
    AveragePooling1D,
    AveragePooling2D,
    AveragePooling3D,
    GlobalAveragePooling1D,
    GlobalAveragePooling2D,
    GlobalMaxPooling1D,
    GlobalMaxPooling2D,
    MaxPooling1D,
    MaxPooling2D,
    MaxPooling3D,
)
from analytics_zoo_tpu_torch.keras.layers.recurrent import (  # noqa: F401
    GRU,
    LSTM,
    Bidirectional,
    SimpleRNN,
    TimeDistributed,
)
from analytics_zoo_tpu_torch.keras.layers.merge import (  # noqa: F401
    Add,
    Average,
    Concat,
    Dot,
    Maximum,
    Merge,
    Minimum,
    Multiply,
    merge,
)
from analytics_zoo_tpu_torch.keras.layers.self_attention import (  # noqa: F401
    BERT,
    TransformerLayer,
)
from analytics_zoo_tpu_torch.keras.layers.advanced_activations import (  # noqa: F401,E501
    ELU,
    LeakyReLU,
    RReLU,
    PReLU,
    SReLU,
    ThresholdedReLU,
)
from analytics_zoo_tpu_torch.keras.layers.elementwise import (  # noqa: F401
    AddConstant,
    BinaryThreshold,
    CAdd,
    CMul,
    Exp,
    Expand,
    ExpandDim,
    GetShape,
    GaussianSampler,
    HardShrink,
    HardTanh,
    Identity,
    Log,
    Masking,
    Max,
    MaxoutDense,
    Mul,
    MulConstant,
    Narrow,
    Negative,
    Power,
    ResizeBilinear,
    Scale,
    Select,
    SelectTable,
    SoftShrink,
    SplitTensor,
    Sqrt,
    Square,
    Squeeze,
    Threshold,
)
from analytics_zoo_tpu_torch.keras.layers.local import (  # noqa: F401
    LocallyConnected1D,
    LocallyConnected2D,
)
from analytics_zoo_tpu_torch.keras.layers.convolutional_recurrent import (  # noqa: F401,E501
    ConvLSTM2D,
    ConvLSTM3D,
)
from analytics_zoo_tpu_torch.keras.layers.noise import (  # noqa: F401
    GaussianDropout,
    SpatialDropout1D,
    SpatialDropout2D,
    SpatialDropout3D,
)
from analytics_zoo_tpu_torch.keras.layers.conv import (  # noqa: F401
    Cropping1D,
    Cropping3D,
    UpSampling3D,
    ZeroPadding3D,
)
from analytics_zoo_tpu_torch.keras.layers.pooling import (  # noqa: F401
    GlobalAveragePooling3D,
    GlobalMaxPooling3D,
)
from analytics_zoo_tpu_torch.keras.layers.embeddings import (  # noqa: F401,E501
    WordEmbedding,
    glove_word_embedding,
    read_glove_vectors,
)
