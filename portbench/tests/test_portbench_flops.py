"""The yardstick's arithmetic on hand-worked shapes."""

from portbench import flops


def test_attention_costs_by_hand():
    # B=1, Tq=Tk=256, H=1, D=64, one bias head
    qkv = 2 * (256 * 64 + 2 * 256 * 64)
    n_bytes, f = flops.flash_fwd_cost(1, 256, 256, 1, 64, 1)
    assert n_bytes == qkv + 2 * 256 * 256 + 256 + 2 * 256 * 64 + 4 * 256
    assert f == 4 * 256 * 256 * 64
    assert flops.flash_fwd_cost(1, 256, 256, 1, 64, 1, out32=True)[0] == n_bytes + 4 * 256 * 64
    n_bytes, f = flops.flash_bwd_cost(1, 256, 256, 1, 64, 1)
    assert f == 10 * 256 * 256 * 64
    assert n_bytes == (qkv + 2 * 256 * 64 + 8 * 256 + 2 * 256 * 256 + 256) + (qkv + 4 * 256 * 256)


def test_bound_takes_the_larger_side():
    assert flops.bound_s(3.35e12, 1.0) == 1.0
    assert flops.bound_s(1.0, 989e12) == 1.0


def test_stack_flops_by_hand():
    cfg = dict(encoder_embed_dim=2, encoder_ffn_embed_dim=4, encoder_layers=1, decoder_embed_dim=2,
               decoder_ffn_embed_dim=4, decoder_layers=1, resnet_type="resnet50")
    # dense 2 (4 E^2 + 2 E F) = 64 a token, attention 4 t^2 E
    assert flops.encoder_flops(cfg, [3]) == 64 * 3 + 4 * 9 * 2
    # decoder: 2 (6 E^2 + 2 E F) = 80 a token, cross k/v 4 E^2 s, self 4 t^2 E / 2, cross 4 t s E, logits 2 E V t
    assert flops.decoder_flops(cfg, 10, [(2, 3)]) == 80 * 2 + 16 * 3 + 16 + 48 + 2 * 2 * 10 * 2
    assert flops.train_update_flops(cfg, 10, [(3, 2)]) == 3 * (264 + 352)
    # decode: cross k/v once, then at step i for each beam the dense products (80), the
    # logits (2 E V = 40), self attention over i + 1 positions (4 (i + 1) E), cross (4 s E)
    def step(i):
        return 80 + 40 + 4 * (i + 1) * 2 + 4 * 3 * 2

    assert flops.decode_flops(cfg, 10, 1, 2, 2, 3) == 16 * 3 + 2 * (step(0) + step(1))


def test_resnet_stem_and_a_stage_by_hand():
    # at 32 px: stem 16x16, pool 8x8; resnet50's stage 1 (3 blocks at 8x8), stage 2 (4 at 4x4), stage 3 (6 at 2x2)
    f = 2 * 16 * 16 * 49 * 3 * 64
    s, cin = 8, 64
    for feats, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2)):
        for i in range(n):
            st = stride if i == 0 else 1
            so = s // st
            f += 2 * s * s * cin * feats + 2 * so * so * 9 * feats * feats + 2 * so * so * feats * 4 * feats
            if i == 0:
                f += 2 * so * so * cin * 4 * feats
            cin, s = 4 * feats, so
    assert flops.resnet_flops("resnet50", 32) == f
