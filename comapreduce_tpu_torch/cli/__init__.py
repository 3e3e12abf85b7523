"""Entry points of the port (``comapreduce_tpu/cli``): the band solve of
the destriping map-maker and the Level-1 -> Level-2 reduction."""
