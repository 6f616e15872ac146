"""Reference-format interop: the pickle codec and its class shims."""
