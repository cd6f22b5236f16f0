"""Training pieces of the port: the chunked CE loss, Adam, and the FL
round driver (ports of ``repro.train``)."""
