"""Check kinds beyond the built-in `error` and `direct_error`
(reference/checks.py): a limits file's `check` = `<kind>` names the module
`portbench.reference.kinds.<kind>`, which gives

- `answers(config, mix, u0, device)`: the reference's answers (n, k) to the
  requests whose inputs are the columns of u0 (n, k), float64;
- `readings(u1, ref)`: one reading per column of the program's answers u1
  against those answers;
- `control(config, mix, u0, device)`: the control's answers to the same
  requests, the reference put in the program's place at the precision next
  below the configuration's.

It receives the configuration and the traffic mix, so it builds its own
operator and dt (reference/operators.py, or its own), and imports nothing of
the port.
"""
