"""Entry points (port of ``repro/launch``): the training launcher, the
parallelism config and the data mesh of the distributed path."""
