# `flash_attention` the function is not re-exported here: the name stays
# the module's, `easydist_tpu_torch.ops.flash_attention`
from .flash_attention import (chunk_attention, decode_attention,
                              flash_attention_lse, flash_bwd_dkv,
                              flash_bwd_dq, flash_decode_attention,
                              flash_fwd, flash_paged_decode_attention,
                              flash_paged_decode_quant_attention,
                              gather_pages, kv_dequantize, kv_quantize,
                              paged_decode_attention)

__all__ = ["chunk_attention", "decode_attention", "flash_attention_lse",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_decode_attention",
           "flash_fwd", "flash_paged_decode_attention",
           "flash_paged_decode_quant_attention", "gather_pages",
           "kv_dequantize", "kv_quantize", "paged_decode_attention"]
