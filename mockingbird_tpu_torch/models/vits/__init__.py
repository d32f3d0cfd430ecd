from .model import (  # noqa: F401
    Vits, TextEncoder, PosteriorEncoder, ResidualCouplingBlock, VitsGenerator,
    DurationPredictor, StochasticDurationPredictor, init_vits, vits_config,
)
from .inference import VitsSynthesizer  # noqa: F401
from .modules import (  # noqa: F401
    WN, DDSConv, ConvFlow, Flip, Log, ElementwiseAffine, ResidualCouplingLayer,
    TransformerEncoder, rational_quadratic_spline, sequence_mask,
    slice_segments, rand_slice_segments, generate_path,
)
from .train import VitsDataset, VitsDiscriminator, BucketBatcher, train  # noqa: F401
