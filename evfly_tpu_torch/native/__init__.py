"""Host-side native libraries of the port (the event accumulator, the flight-stack core), built by ``_build``."""
