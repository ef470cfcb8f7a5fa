"""Drop-in attention interfaces: the port's counterpart of
``magiattention_tpu/extensions/``.

FA-style functions with an attention sink (batch / varlen / qkvpacked,
three generation aliases) over ``flex_flash_attn_func``, and the DSA
top-k sparse interface in plain PyTorch.
"""

from .dsa_interface import (  # noqa: F401
    dsa_attn_func,
    gather_sparse_fwd,
    sdpa_sparse_fwd,
)
from .fa_interface_with_sink import (  # noqa: F401
    fa2_func_with_sink,
    fa2_qkvpacked_func_with_sink,
    fa2_varlen_func_with_sink,
    fa3_func_with_sink,
    fa3_qkvpacked_func_with_sink,
    fa3_varlen_func_with_sink,
    fa4_func_with_sink,
    fa4_qkvpacked_func_with_sink,
    fa4_varlen_func_with_sink,
)
