"""Format layer: bit packing, scheme registry, KV wire format."""
