from .gpt import (GPTConfig, gpt_apply, gpt_decode_step, gpt_init,
                  gpt_prefill, gpt_prefill_chunk, init_kv_cache,
                  params_from_numpy)

__all__ = ["GPTConfig", "gpt_apply", "gpt_decode_step", "gpt_init",
           "gpt_prefill", "gpt_prefill_chunk", "init_kv_cache",
           "params_from_numpy"]
