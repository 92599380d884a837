"""Host-side core of the port: vote codes, errors, state machines, the
persistence trait and engine record, configuration, protocol messages and
their wire codec, the transport seam, validation and the typed SMR API."""
