"""One module a verb, found by the verb's name.

Each ``pmbench/verbs/<verb>.py`` holds the verb's plain reference and the
least work its answer needs:

* ``COLUMNS`` -- the input columns the verb must read;
* ``result_bytes(num_activities, num_cases)`` -- the bytes of its answer,
  written once;
* ``reference(view)`` -- the answer, from a ``pmbench.reference.View``, as
  a dict of named tensors;
* ``program(answer)`` -- the program's answer (as the harness read it back
  to host memory) as a dict of the same names.
"""
