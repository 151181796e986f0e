"""Session plumbing of the port. Only the probe registry is ported so far;
the `Session`, its spec, detectors and sinks come with a later slice."""
