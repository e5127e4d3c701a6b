from .flash_attention import (chunk_attention, decode_attention,
                              flash_decode_attention)

__all__ = ["chunk_attention", "decode_attention", "flash_decode_attention"]
