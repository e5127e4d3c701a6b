from .gpt import (GPTConfig, gpt_apply, gpt_decode_step,
                  gpt_decode_step_paged, gpt_init, gpt_loss, gpt_prefill,
                  gpt_prefill_chunk, gpt_prefill_chunk_paged, init_kv_cache,
                  init_kv_pages, make_gpt_train_step, params_from_numpy,
                  stack_gpt_blocks)
from .llama import (LlamaConfig, llama_apply, llama_decode_step,
                    llama_init, llama_prefill, llama_prefill_chunk,
                    make_llama_train_step)
from .llama import init_kv_cache as llama_init_kv_cache
from .mlp import make_mlp_train_step, mlp_apply, mlp_init
from .optim import (adagrad_init, adagrad_update, adam_init, adam_update,
                    adamw_update, rmsprop_init, rmsprop_update, sgd_init,
                    sgd_update, value_and_grad)

__all__ = ["GPTConfig", "gpt_apply", "gpt_decode_step",
           "gpt_decode_step_paged", "gpt_init", "gpt_loss", "gpt_prefill",
           "gpt_prefill_chunk", "gpt_prefill_chunk_paged", "init_kv_cache",
           "init_kv_pages", "make_gpt_train_step", "params_from_numpy",
           "stack_gpt_blocks",
           "LlamaConfig", "llama_apply", "llama_decode_step", "llama_init",
           "llama_init_kv_cache", "llama_prefill", "llama_prefill_chunk",
           "make_llama_train_step",
           "make_mlp_train_step", "mlp_apply", "mlp_init",
           "adagrad_init", "adagrad_update", "adam_init", "adam_update",
           "adamw_update", "rmsprop_init", "rmsprop_update", "sgd_init",
           "sgd_update", "value_and_grad"]
