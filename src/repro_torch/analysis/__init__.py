"""The dry-run's analysis on the port (counterpart of ``repro/analysis``):
``count`` (the step's work counted op by op, the stand-in for XLA's
``cost_analysis()`` and ``memory_analysis()``), ``collectives`` (the
collectives a step makes under a mesh plan, priced by the reference's
ring formulas, in place of parsing HLO) and ``roofline`` (the three-term
roofline).  Modules are imported by name."""
