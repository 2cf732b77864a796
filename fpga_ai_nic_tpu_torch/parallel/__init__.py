"""Virtual data-parallel ranks and the trainer of the port."""
