"""Testing support: precision asserts, the overlap-safety check, the dense
ground-truth attention, the brute-force dispatcher, the env-flag
combinations and kernel/plan pre-warming."""

from .flag_generator import FlagCombGenerator, with_flags  # noqa: F401
from .gt_dispatcher import GroundTruthDispatcher  # noqa: F401
from .precision import assert_close, mismatch_ratio, rel_norm_err  # noqa: F401
from .precompile import precompile_ffa, precompile_kernels  # noqa: F401
from .ref_attn import ref_attn, ref_max_logits  # noqa: F401
from .template import assert_overlap_safe  # noqa: F401
