"""Kinds of traffic, one module each, found by a traffic file's ``kind``:
``run(ctx)`` builds the system under test over the program, offers the
load for the window, and compares what the timed path produced with the
plain reference; ``reading(ctx, variant)`` gives the numbers of the check
for the calibration (the sound program, the control, a planted fault)."""
