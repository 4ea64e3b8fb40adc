"""OverSketched Newton core: sketching, coded computation, the fleet clock
and the Newton loop."""
from repro_torch.core.coded import (ProductCode, coded_matvec, decode_matvec,
                                    detect_corrupted, encode_2d, make_code,
                                    peel_decode, verified_decode)
from repro_torch.core.newton import (NewtonConfig, NewtonResult,
                                     oversketched_newton)
from repro_torch.core.objectives import (Dataset, LassoDualIPM,
                                         LinearProgramIPM, LogisticRegression,
                                         RidgeRegression, SoftmaxRegression)
from repro_torch.core.sketch import (CountSketch, OverSketchConfig,
                                     apply_sketch, oversketched_gram,
                                     sample_countsketch, sketched_gram)
from repro_torch.core.straggler import SimClock, StragglerModel

__all__ = [
    "ProductCode", "coded_matvec", "decode_matvec", "encode_2d", "make_code",
    "peel_decode", "detect_corrupted", "verified_decode", "NewtonConfig", "NewtonResult", "oversketched_newton",
    "Dataset", "LogisticRegression", "SoftmaxRegression", "RidgeRegression",
    "LinearProgramIPM", "LassoDualIPM", "CountSketch", "OverSketchConfig",
    "apply_sketch", "oversketched_gram", "sample_countsketch",
    "sketched_gram", "SimClock", "StragglerModel",
]
