"""Test infrastructure shipped with the port (cassette record/replay;
the counterpart of ``aigw_tpu/testing``) — the reference ships the
equivalent under ``tests/internal/testopenai`` as an importable
package."""

from aigw_tpu_torch.testing.cassettes import (  # noqa: F401
    Cassette,
    CassetteServer,
    Interaction,
    load_cassette,
)
