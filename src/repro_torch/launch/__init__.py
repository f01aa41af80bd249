"""Entry points (port of ``repro/launch``): the single-device training
launcher so far."""
