"""Small utilities of the port (the counterpart of easydist_tpu/utils/):
`dump` writes the MetaIR as graphviz DOT."""
