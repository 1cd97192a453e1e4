"""Spec-conformance harness (the analog of the reference's ``testing/ef_tests``).

Two layers:

- :mod:`handler` — a generic directory-walking handler for the official
  ``consensus-spec-tests`` tarballs, mirroring the reference's
  ``testing/ef_tests/src/handler.rs:10-70``: cases live at
  ``tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>`` and each runner
  maps to a typed case function.  Drop a tarball under ``tests/ef_vectors/``
  (or point ``EF_TESTS_DIR`` at one) and the full suite runs.

- vendored known-answer vectors in ``tests/vectors/`` — external constants
  that ship in-repo (EIP-2333 spec cases, interop keygen pairs,
  staking-deposit-cli 2.7.0 signatures/roots) so the bit-exactness gate runs
  with zero network access.

A copy of the JAX package's ``lighthouse_tpu/conformance/__init__.py``.
"""

from .handler import discover_cases, run_case  # noqa: F401
