"""The parts of the simulator that the deployment path flies: the quadrotor
state (``dynamics``), the native flight-stack core (``native_quad``) and the
pilot state machine (``pilot``)."""
