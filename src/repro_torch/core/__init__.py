"""D2FT core: subnet scores, the bi-level knapsack, schedules and their
gates, and the cost model (port of ``repro/core/``)."""
