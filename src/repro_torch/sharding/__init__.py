"""Gradient synchronization of the distributed D2FT step (port of
``repro/sharding``): the schedule-masked sync so far."""
