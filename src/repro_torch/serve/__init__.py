"""The paged continuous-batching serving path of the port."""
