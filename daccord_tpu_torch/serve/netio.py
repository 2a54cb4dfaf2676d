"""End-to-end integrity names of the serve plane's HTTP exchanges.

The port's copy of the two constants of the JAX package's
``serve/netio.py`` that ``serve/http.py`` sends: a body byte count that
survives proxies which re-frame the body (Content-Length does not), and a
streamed result's byte-count trailer. The rest of ``netio`` (the verified
client, deadlines and retries the router proxies through) comes with the
router.
"""

#: end-to-end integrity headers (survive proxies that re-frame the body,
#: which Content-Length does not)
BODY_BYTES_HEADER = "X-Daccord-Body-Bytes"
STREAM_BYTES_TRAILER = "X-Daccord-Stream-Bytes"
