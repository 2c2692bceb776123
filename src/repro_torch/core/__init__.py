"""MG-WFBP core: cost model, planner, simulator, bucketer, collectives."""
