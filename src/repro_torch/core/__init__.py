"""The paper's tuning machinery on the port (counterpart of
``repro/core``): the op graph and its widths, the analytic cost model,
the guideline tuner with its baselines, and the exhaustive sweep.  Pure
host analysis: nothing here touches a device."""

from repro_torch.core import autotune, cost_model, graph, tuner
from repro_torch.core.graph import OpGraph, build_graph
from repro_torch.core.tuner import (Plan, guideline_plan, intel_setting,
                                    make_rules, tf_setting)

__all__ = ["autotune", "cost_model", "graph", "tuner",
           "OpGraph", "build_graph", "Plan", "guideline_plan",
           "intel_setting", "make_rules", "tf_setting"]
