"""Solution artifacts and exporters.  Submodules load on demand: the
ParaView and HTML exporters are not needed by `padne-tpu solve`."""
