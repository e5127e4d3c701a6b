"""Small utilities of the port (the counterpart of easydist_tpu/utils/):
`dump` writes the MetaIR as graphviz DOT; `timer` holds the two-point
host-clock timing (`EDTimer`, `two_point_time`, `host_sync`)."""
