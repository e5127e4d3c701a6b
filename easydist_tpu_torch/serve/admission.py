"""Serving-layer errors the generation session raises (the subset of
easydist_tpu/serve/admission.py the session path needs)."""


class ServeError(Exception):
    """Base class for serving-layer failures."""


class RequestTooLargeError(ServeError):
    """A request dimension exceeds the largest configured bucket."""


class ReplicaDrainingError(ServeError):
    """The session is closed: it admits nothing new."""
