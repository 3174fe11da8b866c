"""Engine: options, state, hardware, robot assembly and the stepping engine."""
