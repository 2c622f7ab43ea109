"""Server-side subsystems of the port (so far: the shared waterfall)."""
