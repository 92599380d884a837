"""Applications of the port: the binary KV op codec, the columnar vector
KV store and the device-resident KV table."""
