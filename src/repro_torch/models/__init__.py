"""Model definitions written against the backend interface."""
