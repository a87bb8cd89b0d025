"""Model variants of the port: the core DESMO model (``models.desmo``)."""
