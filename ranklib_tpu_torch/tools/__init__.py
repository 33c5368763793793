"""Tools beside the port: the compiler probes (:mod:`.probes`)."""
