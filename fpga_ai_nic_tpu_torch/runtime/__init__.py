"""Runtime pieces of the port: request intake, the error classes the
serving engine's recovery tells apart, the explicit collective queue
(``queue``) and the native batch staging (``staging``, built by
``native``)."""
