"""Flat env-var-driven knobs of the port (the subset of
easydist_tpu/config.py that the serving path, the ShardCombine engine,
the solver and the multi-device frontend read, under the same names and
environment variables).

Every knob is a module global, read from its environment variable at
import time and mutable at runtime.  Imported as `edconfig`.
"""

import logging
import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# attention backend of the cache-carrying decode steps: "auto" (the CUDA
# kernel for CUDA tensors, the plain PyTorch version for CPU tensors),
# "flash" / "paged" (force the kernel; raises on a CPU tensor — "paged"
# names the page-table kernels, and the contiguous path treats it as
# "auto"), "xla" (force the plain version — named after the JAX package's
# masked dot_general path; raises on a CUDA tensor, so the card always
# runs the kernel).
decode_attention_backend = os.environ.get("EASYDIST_DECODE_ATTENTION",
                                          "auto")
# keys one online-softmax step of the decode kernel takes: B4's split of a
# row, halved while a split would not fit shared memory.
decode_block_k = _env_int("EASYDIST_DECODE_BLOCK_K", 256)
# attention backend of the chunked-prefill pass: "auto" | "xla" — both
# resolve to the plain PyTorch masked einsum.
prefill_attention_backend = os.environ.get("EASYDIST_PREFILL_ATTENTION",
                                           "auto")


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


# ---------------- ShardCombine discovery (metashard/) ----------------
# number of shards a candidate sharding is executed with
discovery_nshards = _env_int("EASYDIST_DISCOVERY_NSHARDS", 2)
# device the discovery probes' inputs are placed on (`platform.from_numpy`):
# the card by default, like every entry point of the port; "cpu" on
# request (the tests pass it).  `chip_smoke.py` times both.
discovery_device = os.environ.get("EASYDIST_DISCOVERY_DEVICE", "cuda")
# allclose tolerance of the recombination checks; float32 with TF32 off
# (discovery turns it off while it probes)
allclose_rtol = _env_float("EASYDIST_ALLCLOSE_RTOL", 1e-3)
allclose_atol = _env_float("EASYDIST_ALLCLOSE_ATOL", 1e-5)
# also try halo and block-cyclic recombinations of the gather space
extend_space = _env_bool("EASYDIST_EXTEND_SPACE", True)
# cap on candidate shardings executed per shard group (the search is
# exponential in the number of tensor arguments)
discovery_max_candidates = _env_int("EASYDIST_DISCOVERY_MAX_CANDIDATES", 4096)
# run a candidate's shards as one vmapped call instead of one call per
# shard; an op without a batching rule falls back to the loop
discovery_batch_probes = _env_bool("EASYDIST_DISCOVERY_BATCH_PROBES", True)
# an op whose inputs and outputs hold more elements than this is
# discovered on a proportionally shrunk instance (fxfront/interpreter.py)
discovery_hint_numel = _env_int("EASYDIST_DISCOVERY_HINT_NUMEL", 2**24)
# propagation groups: discover once per dim-role-canonical signature and
# instantiate the rule for the other members (fxfront/discovery.py)
discovery_prune = _env_bool("EASYDIST_DISCOVERY_PRUNE", True)
# persist discovered rules across processes, keyed by canonical signature
# and a salt of the knobs, torch's version and the discovery device type
discovery_persistent_cache = _env_bool("EASYDIST_DISCOVERY_CACHE", True)
# cache directory; empty = "<compile_cache_dir>/discovery"
discovery_cache_dir = os.environ.get("EASYDIST_DISCOVERY_CACHE_DIR", "")
# resolve aten ops with an analytic rule (fxfront/presets.py) first
discovery_use_presets = _env_bool("EASYDIST_DISCOVERY_PRESETS", True)
# execute-validate every preset rule against the ShardCombine harness on
# small shapes (an audit of the preset bank: failures are counted and
# logged, never raised)
discovery_crosscheck = _env_bool("EASYDIST_DISCOVERY_CROSSCHECK", False)

# ---------------- dumps (fxfront/api.py `_dump_strategies`) ----------------
# directory for the solved MetaIR, clusters, strategies, the DOT graph and
# each emitted rank program's code (None: no dump)
dump_dir = os.environ.get("EASYDIST_DUMP_DIR", None)
dump_strategy = _env_bool("EASYDIST_DUMP_STRATEGY", True)
dump_cluster = _env_bool("EASYDIST_DUMP_CLUSTER", False)
# graphviz DOT of the MetaIR graph with the chosen placements
dump_graphviz = _env_bool("EASYDIST_DUMP_GRAPHVIZ", True)

# ---------------- static analyzer (easydist_tpu_torch.analyze) ----------------
# run the strategy verifier and the solver objective audit after every
# per-axis solve, the discovery transfer audit after every trace, the
# schedule, page-handoff, resume and drain hooks (pure Python over built
# structures)
enable_analyze = _env_bool("EASYDIST_ANALYZE", True)
# error-severity findings raise AnalysisError; 0 demotes them to logging
analyze_raise = _env_bool("EASYDIST_ANALYZE_RAISE", True)
# MEM004 budget in bytes a device: -1 = ask the card (`torch.cuda`'s total
# memory; `hbm_capacity_default` where no CUDA device answers), 0 = gate
# off, > 0 = this budget.  It only verifies; `per_device_memory_cap`
# drives remat.
analyze_hbm_budget = _env_int("EASYDIST_ANALYZE_HBM_BUDGET", -1)
# the device memory assumed where no CUDA device answers: an H100 80GB
# HBM3's `total_memory` as torch reports it (PERF.md)
hbm_capacity_default = _env_int("EASYDIST_HBM_CAPACITY", 85_017_493_504)
# SCHED003: warn above this static bubble fraction of a tick schedule
analyze_bubble_warn_frac = _env_float("EASYDIST_ANALYZE_BUBBLE_WARN", 0.6)

# ---------------- frontend (fxfront/) ----------------
# persistent per-graph strategy cache: a hit skips discovery and solving
enable_compile_cache = _env_bool("EASYDIST_COMPILE_CACHE", False)
compile_cache_dir = os.environ.get("EASYDIST_COMPILE_CACHE_DIR",
                                   "./.easydist_cache")
# cone clustering before each axis's solve (level 0: one node a cluster)
enable_graph_coarsen = _env_bool("EASYDIST_ENABLE_GRAPH_COARSEN", True)
coarsen_level = _env_int("EASYDIST_COARSEN_LEVEL", 1)
# let a later mesh axis pick the strategy an earlier axis chose for a node
allow_repeated_axis_strategy = _env_bool(
    "EASYDIST_ALLOW_REPEATED_AXIS_STRATEGY", False)
# partial placements ride linear aten ops in the solver's pools
enable_partial_pools = _env_bool("EASYDIST_PARTIAL_POOLS", True)
# warn when more than this fraction of the modeled FLOPs run replicated
replicate_warn_threshold = _env_float("EASYDIST_REPLICATE_WARN_THRESHOLD",
                                      0.5)

# ---------------- solver (autoflow/) ----------------
solver_time_limit = _env_float("EASYDIST_SOLVER_TIME_LIMIT", 60.0)
solver_mip_rel_gap = _env_float("EASYDIST_SOLVER_MIP_REL_GAP", 1e-3)
all_to_all_punish_factor = _env_float("EASYDIST_ALL_TO_ALL_PUNISH", 3.0)
solver_backend = os.environ.get("EASYDIST_SOLVER", "milp")  # milp | beam
beam_width = _env_int("EASYDIST_BEAM_WIDTH", 100)
# tie the ILP variables of isomorphic clusters (repeated layers)
solver_cluster_dedup = _env_bool("EASYDIST_SOLVER_CLUSTER_DEDUP", True)
# per-device memory cap in bytes: > 0 is a hard cap per liveness step,
# 0 is off, -1 is "ask the device" (`schedule.remat.resolve_memory_cap`:
# the CUDA device's total memory, uncapped on the CPU).  The solver reads
# a cap > 0 as it is; the remat planner reads the resolved cap.  Both
# scale it by `memory_ratio`.
per_device_memory_cap = _env_int("EASYDIST_MEMORY_CAP", -1)
memory_ratio = _env_float("EASYDIST_MEMORY_RATIO", 0.9)
# compiler-chosen rematerialization when the planned peak exceeds the
# resolved cap (schedule/remat.py); most nodes one recompute chain holds
enable_auto_remat = _env_bool("EASYDIST_AUTO_REMAT", True)
remat_max_chain_len = _env_int("EASYDIST_REMAT_MAX_CHAIN", 96)
# checkpoint policy of a compiled forward that a caller differentiates
# through: "none" | "dots" (save matmul outputs) | "all" (save nothing)
remat_policy = os.environ.get("EASYDIST_REMAT_POLICY", "none")
# cap only placeholder tensors (parameters and state) per liveness step
liveness_only_input = _env_bool("EASYDIST_LIVENESS_ONLY_INPUT", False)
# discount a resharding edge by the independent compute that can hide it
# (autoflow.cost_model.overlap_discount_ratio resolves the ratio:
# "auto" = measured when recorded, else `comm_overlap_ratio`;
# "measured" = measured or 0; "config" = `comm_overlap_ratio`)
predict_comm_overlap = _env_bool("EASYDIST_PREDICT_COMM_OVERLAP", False)
comm_overlap_ratio = _env_float("EASYDIST_COMM_OVERLAP_RATIO", 0.5)
comm_overlap_ratio_source = os.environ.get("EASYDIST_COMM_OVERLAP_SOURCE",
                                           "auto")
# achieved overlap fraction measured over a process group, or None:
# `runtime.calibrate.calibrate_overlap` records it; until then "auto"
# resolves to `comm_overlap_ratio`
comm_overlap_ratio_measured = None

# ---------------- hardware constants of the cost model ----------------
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate
peak_flops = _env_float("EASYDIST_PEAK_FLOPS", 989e12)
hbm_bandwidth = _env_float("EASYDIST_HBM_BANDWIDTH", 3.35e12)
# NVIDIA H100 SXM: NVLink 4, 900 GB/s both directions, 450 GB/s each way
nvlink_bandwidth = _env_float("EASYDIST_NVLINK_BANDWIDTH", 450e9)
# NDR InfiniBand between hosts: 400 Gb/s = 50 GB/s a port
ib_bandwidth = _env_float("EASYDIST_IB_BANDWIDTH", 50e9)
# alpha term, seconds per collective launch: placeholders until
# `runtime.calibrate.calibrate(group)` measures them over two or more cards
nvlink_latency = _env_float("EASYDIST_NVLINK_LATENCY", 5e-6)
ib_latency = _env_float("EASYDIST_IB_LATENCY", 1e-5)

# ---------------- gradient-collective compression (comm/) ----------------
# wire dtype of gradient reductions and of the solver's reduction fences:
# "none" (exact, one collective per leaf) | "int8" (two-pass block-scaled,
# ~3.9x fewer wire bytes) | "bf16" (cast, 2x)
comm_quant_dtype = os.environ.get("EASYDIST_COMM_QUANT", "none")
# elements per int8 scaling block (one f32 scale each)
comm_quant_block = _env_int("EASYDIST_COMM_QUANT_BLOCK", 256)
# pack gradient leaves into buckets of at most this many bytes before
# reducing (0 = one collective per leaf)
comm_bucket_bytes = _env_int("EASYDIST_COMM_BUCKET_BYTES", 0)
# leaves whose keystr path matches this regex (case-insensitive) stay
# exact: norm gains and biases are small and sensitive to quantization
# (`'b'` catches the models' bias keys, as in "['blocks'][0]['ln1']['b']")
comm_quant_skip = os.environ.get(
    "EASYDIST_COMM_QUANT_SKIP", r"bias|norm|\bln\b|scale|gamma|beta|'b'")
# leaves below this many elements are never quantized
comm_quant_min_numel = _env_int("EASYDIST_COMM_QUANT_MIN_NUMEL", 2048)
# flush gradient buckets in backward emission order, each issued from the
# backward as soon as its last gradient exists (comm/overlap.py)
comm_overlap = _env_bool("EASYDIST_COMM_OVERLAP", False)
# K-microbatch gradient accumulation of the manual dp / ZeRO steps
# (0 and 1 both mean off); the steps' `grad_accum_microbatches=` wins
grad_accum_microbatches = _env_int("EASYDIST_GRAD_ACCUM_MICROBATCHES", 0)
# replace `peak_flops` / `hbm_bandwidth` with the card's datasheet values
# at compile time (runtime/calibrate.py; unknown kinds keep the defaults)
auto_device_constants = _env_bool("EASYDIST_AUTO_DEVICE_CONSTANTS", True)
# load measured alpha / beta / HBM values from the PerfDB when present
# (`runtime.calibrate.calibrate(group)` records them)
auto_calibration = _env_bool("EASYDIST_AUTO_CALIBRATION", True)

# ---------------- reshard (easydist_tpu_torch.reshard) ----------------
# chunk ceiling (bytes) of a redistribution plan: the "+ chunk" term of
# the O(max(src_shard, dst_shard) + chunk) peak-live-bytes bound.  A plan
# step stages at most this much beside one source and one destination
# shard; the restore's `elastic.restore.oom` recovery halves it and
# replans.  Salts nothing that is compiled.
reshard_chunk_bytes = _env_int("EASYDIST_RESHARD_CHUNK_BYTES", 64 * 2**20)

# ---------------- resilience (resilience/, runtime/) ----------------
# deterministic fault schedule, e.g. "step.nan_grad@7,ckpt.write.partial@2":
# names from resilience.faultinject.FAULT_POINTS; the elastic loop arms it
fault_plan = os.environ.get("EASYDIST_FAULT_PLAN", "")
# the NaN/Inf skip-and-hold guard of the dp / ZeRO steps and run_training
resilience_step_guard = _env_bool("EASYDIST_STEP_GUARD", False)
# consecutive non-finite steps the guard holds before raising
resilience_guard_max_skips = _env_int("EASYDIST_GUARD_MAX_SKIPS", 8)
# the overflow scale decays by this factor on each held step ...
resilience_guard_scale_decay = _env_float("EASYDIST_GUARD_SCALE_DECAY", 0.5)
# ... and doubles back (capped at its initial value) after this many
# clean steps
resilience_guard_scale_growth_every = _env_int(
    "EASYDIST_GUARD_GROWTH_EVERY", 200)
# checkpoint I/O retries: exponential backoff with jitter
resilience_ckpt_retries = _env_int("EASYDIST_CKPT_RETRIES", 3)
resilience_ckpt_backoff_s = _env_float("EASYDIST_CKPT_BACKOFF", 0.05)
resilience_ckpt_backoff_jitter = _env_float("EASYDIST_CKPT_JITTER", 0.25)
# SIGTERM grace budget the final checkpoint must land inside
resilience_preempt_grace_s = _env_float("EASYDIST_PREEMPT_GRACE", 30.0)
# a batch fetch of the elastic loop that takes longer raises
# DataStallError (0 = watchdog off)
resilience_data_timeout_s = _env_float("EASYDIST_DATA_TIMEOUT", 0.0)


def _validate_resilience() -> None:
    """Fail at import on out-of-range resilience knobs."""
    checks = (
        ("EASYDIST_GUARD_MAX_SKIPS", resilience_guard_max_skips,
         resilience_guard_max_skips >= 1, ">= 1"),
        ("EASYDIST_GUARD_SCALE_DECAY", resilience_guard_scale_decay,
         0.0 < resilience_guard_scale_decay <= 1.0, "in (0, 1]"),
        ("EASYDIST_GUARD_GROWTH_EVERY", resilience_guard_scale_growth_every,
         resilience_guard_scale_growth_every >= 1, ">= 1"),
        ("EASYDIST_CKPT_RETRIES", resilience_ckpt_retries,
         resilience_ckpt_retries >= 0, ">= 0"),
        ("EASYDIST_CKPT_BACKOFF", resilience_ckpt_backoff_s,
         resilience_ckpt_backoff_s >= 0, ">= 0"),
        ("EASYDIST_CKPT_JITTER", resilience_ckpt_backoff_jitter,
         0.0 <= resilience_ckpt_backoff_jitter <= 1.0, "in [0, 1]"),
        ("EASYDIST_PREEMPT_GRACE", resilience_preempt_grace_s,
         resilience_preempt_grace_s > 0, "> 0"),
        ("EASYDIST_DATA_TIMEOUT", resilience_data_timeout_s,
         resilience_data_timeout_s >= 0, ">= 0"))
    for env, value, ok, want in checks:
        if not ok:
            raise ValueError(f"{env} must be {want}, got {value}")


_validate_resilience()

# ---------------- op-time database ----------------
prof_db_path = os.environ.get(
    "EASYDIST_PERF_DB", os.path.expanduser("~/.easydist_tpu_torch/perf.db"))
# fenced per-step seconds of every compiled call after the first, into the
# PerfDB under ("step_times", <function name>)
enable_runtime_prof = _env_bool("EASYDIST_RUNTIME_PROF", False)
# price the solver's compute redundancy with measured per-op seconds from
# the PerfDB where a node's signature hits
use_op_cost_db = _env_bool("EASYDIST_OP_COST_DB", True)

# ---------------- serving (serve/) ----------------
# speculative decoding defaults: `ServeConfig.speculate_k` and
# `.speculate_drafter` read these at construction when not set explicitly
# (k = draft tokens a verify round scores; 0 disables speculation)
speculate_k = _env_int("EASYDIST_SPECULATE_K", 0)
speculate_drafter = os.environ.get("EASYDIST_SPECULATE_DRAFTER", "ngram")

# ---------------- logging (easydist_setup) ----------------
log_level = getattr(logging, os.environ.get("EASYDIST_LOGLEVEL",
                                            "INFO").upper())
