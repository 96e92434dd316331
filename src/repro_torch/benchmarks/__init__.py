"""The port's benchmark entry point (``run``) and its tables (``tables``)."""
