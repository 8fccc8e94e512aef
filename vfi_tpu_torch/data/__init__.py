"""Host data pipeline of the port: clip datasets, batching, prefetching, the native loader."""
