"""Device pricers of the port (the counterpart of ``repro.core.engines``)."""
