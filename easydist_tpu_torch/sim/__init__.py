"""Calibrated performance simulator, capacity planner, and SLO
autoscaler (port of easydist_tpu/sim).

Three connected layers over one cost vocabulary:

  `sim.simulate`   discrete-event replay of a solved MetaIR graph or of a
                   traced one-device program — op times from the PerfDB
                   op-profile/calibrate datasheet, a host stream that
                   issues every replayed call, collective times and
                   overlap discounts from `autoflow.cost_model`, pipeline
                   schedules replayed from the 1F1B tick tables.
                   Predicts train step time, decode tokens/s at a given
                   occupancy, and TTFT under chunked prefill, validated
                   against measured programs within
                   `SIM_REL_ERROR_BOUND`.
  `sim.capacity`   MeshDesc + TrafficSpec + SLO -> ranked replica plans
                   through the simulator plus an open-loop queueing
                   layer over the router's least-loaded dispatch.
  `sim.autoscale`  the control loop: ServeMetrics occupancy/p99 via
                   PerfDB snapshots, planner target with hysteresis,
                   FleetRouter drain / replica spin-up actuation.
"""

from .autoscale import Autoscaler, AutoscaleConfig, MetricsView
from .capacity import (SLO, CapacityPlan, CapacityPlanner, ReplicaProfile,
                       TrafficSpec)
from .events import Event, EventLog, ServerPool, Stream, percentile
from .simulate import (DISPATCH_KEY, RESIDUAL_KEY, SIM_REL_ERROR_BOUND,
                       OpTimeTable, SimReport, load_residual,
                       measure_launch_floor, predict_decode_throughput,
                       predict_fn_seconds, predict_pipeline_step,
                       predict_ttft, relative_error, replay_graph,
                       simulate_pipeline, simulate_train_step,
                       store_dispatch, store_launch_floor,
                       store_residual)

__all__ = [
    "Autoscaler", "AutoscaleConfig", "MetricsView",
    "SLO", "CapacityPlan", "CapacityPlanner", "ReplicaProfile",
    "TrafficSpec",
    "Event", "EventLog", "ServerPool", "Stream", "percentile",
    "DISPATCH_KEY", "RESIDUAL_KEY", "SIM_REL_ERROR_BOUND", "OpTimeTable",
    "SimReport", "load_residual", "measure_launch_floor",
    "predict_decode_throughput", "predict_fn_seconds",
    "predict_pipeline_step", "predict_ttft", "relative_error",
    "replay_graph", "simulate_pipeline", "simulate_train_step",
    "store_dispatch", "store_launch_floor", "store_residual",
]
