"""Tables behind XLA's float32 ``rsqrt`` and ``pow`` on x86 hosts.

XLA's CPU backend computes ``rsqrt(x)`` as ``rsqrtss`` refined by two
Newton steps (``ops/stats.py::rsqrt_xla``), so its last bits follow the
estimate.  On Intel CPUs the estimate depends on the exponent's parity and
the top 10 mantissa bits only: ``_RSQRT_TABLE`` holds the 2048 estimates
for inputs ``x = 1 + j/1024`` (``j < 1024``) and ``x = 2 + (j - 1024)/512``,
each as the 16-bit word ``bits >> 11`` of the float32 estimate (whose top
four bits are 0b0111 and whose low 11 bits are zero).  Read from the host
with ``python3 psrsigsim_torch/tools/rsqrt_table.py``.

XLA's CPU backend calls the C library's ``powf`` for a float32 power.
glibc's (2.28 and later; its FMA build on hosts with FMA) computes
``log2(x)`` from a 16-entry table of ``(1/c, log2(c))`` and a degree-5
polynomial, multiplies by ``y``, and takes ``exp2`` from a 32-entry table
and a degree-3 polynomial, all in float64 (``ops/stats.py::powf``).  The
words below are the float64 bits of its ``__powf_log2_data`` (the table,
then the polynomial) and ``__exp2f_data`` (the table, the shift
``0x1.8p+52/32``, then the polynomial), read from glibc 2.36's ``libm``.
"""

_RSQRT_TABLE = (
    "effeeffaeff6eff2efeeefeaefe6efe2efdeefdaefd6efd2efceefcbefc7efc3efbfefbb"
    "efb7efb3efafefabefa7efa4efa0ef9cef98ef94ef90ef8cef89ef85ef81ef7def79ef76"
    "ef72ef6eef6aef66ef63ef5fef5bef57ef54ef50ef4cef48ef45ef41ef3def39ef36ef32"
    "ef2eef2bef27ef23ef20ef1cef18ef15ef11ef0def0aef06ef02eeffeefbeef7eef4eef0"
    "eeedeee9eee5eee2eedeeedbeed7eed3eed0eecceec9eec5eec2eebeeebaeeb7eeb3eeb0"
    "eeaceea9eea5eea2ee9eee9bee97ee94ee90ee8dee89ee86ee82ee7fee7bee78ee75ee71"
    "ee6eee6aee67ee63ee60ee5dee59ee56ee52ee4fee4cee48ee45ee41ee3eee3bee37ee34"
    "ee31ee2dee2aee26ee23ee20ee1cee19ee16ee12ee0fee0cee09ee05ee02edffedfbedf8"
    "edf5edf1edeeedebede8ede4ede1eddeeddbedd7edd4edd1edceedcaedc7edc4edc1edbe"
    "edbaedb7edb4edb1edaeedaaeda7eda4eda1ed9eed9bed97ed94ed91ed8eed8bed88ed84"
    "ed81ed7eed7bed78ed75ed72ed6fed6bed68ed65ed62ed5fed5ced59ed56ed53ed50ed4d"
    "ed49ed46ed43ed40ed3ded3aed37ed34ed31ed2eed2bed28ed25ed22ed1fed1ced19ed16"
    "ed13ed10ed0ded0aed07ed04ed01ecfeecfbecf8ecf5ecf2ecefececece9ece6ece3ece0"
    "ecddecdbecd8ecd5ecd2eccfecccecc9ecc6ecc3ecc0ecbdecbaecb8ecb5ecb2ecafecac"
    "eca9eca6eca3eca1ec9eec9bec98ec95ec92ec8fec8dec8aec87ec84ec81ec7eec7cec79"
    "ec76ec73ec70ec6eec6bec68ec65ec62ec60ec5dec5aec57ec54ec52ec4fec4cec49ec47"
    "ec44ec41ec3eec3cec39ec36ec33ec31ec2eec2bec28ec26ec23ec20ec1eec1bec18ec15"
    "ec13ec10ec0dec0bec08ec05ec03ec00ebfdebfbebf8ebf5ebf3ebf0ebedebebebe8ebe5"
    "ebe3ebe0ebddebdbebd8ebd5ebd3ebd0ebceebcbebc8ebc6ebc3ebc0ebbeebbbebb9ebb6"
    "ebb3ebb1ebaeebaceba9eba7eba4eba1eb9feb9ceb9aeb97eb95eb92eb8feb8deb8aeb88"
    "eb85eb83eb80eb7eeb7beb79eb76eb73eb71eb6eeb6ceb69eb67eb64eb62eb5feb5deb5a"
    "eb58eb55eb53eb50eb4eeb4beb49eb46eb44eb41eb3feb3deb3aeb38eb35eb33eb30eb2e"
    "eb2beb29eb26eb24eb22eb1feb1deb1aeb18eb15eb13eb11eb0eeb0ceb09eb07eb05eb02"
    "eb00eafdeafbeaf9eaf6eaf4eaf1eaefeaedeaeaeae8eae5eae3eae1eadeeadceadaead7"
    "ead5ead3ead0eaceeacbeac9eac7eac4eac2eac0eabdeabbeab9eab6eab4eab2eaafeaad"
    "eaabeaa8eaa6eaa4eaa2ea9fea9dea9bea98ea96ea94ea91ea8fea8dea8bea88ea86ea84"
    "ea82ea7fea7dea7bea78ea76ea74ea72ea6fea6dea6bea69ea66ea64ea62ea60ea5dea5b"
    "ea59ea57ea55ea52ea50ea4eea4cea49ea47ea45ea43ea41ea3eea3cea3aea38ea36ea33"
    "ea31ea2fea2dea2bea28ea26ea24ea22ea20ea1dea1bea19ea17ea15ea13ea10ea0eea0c"
    "ea0aea08ea06ea04ea01e9ffe9fde9fbe9f9e9f7e9f5e9f2e9f0e9eee9ece9eae9e8e9e6"
    "e9e4e9e1e9dfe9dde9dbe9d9e9d7e9d5e9d3e9d1e9cee9cce9cae9c8e9c6e9c4e9c2e9c0"
    "e9bee9bce9bae9b7e9b5e9b3e9b1e9afe9ade9abe9a9e9a7e9a5e9a3e9a1e99fe99de99b"
    "e999e997e994e992e990e98ee98ce98ae988e986e984e982e980e97ee97ce97ae978e976"
    "e974e972e970e96ee96ce96ae968e966e964e962e960e95ee95ce95ae958e956e954e952"
    "e950e94ee94ce94ae948e946e944e942e940e93ee93ce93ae938e937e935e933e931e92f"
    "e92de92be929e927e925e923e921e91fe91de91be919e917e916e914e912e910e90ee90c"
    "e90ae908e906e904e902e900e8ffe8fde8fbe8f9e8f7e8f5e8f3e8f1e8efe8ede8ece8ea"
    "e8e8e8e6e8e4e8e2e8e0e8dee8dce8dbe8d9e8d7e8d5e8d3e8d1e8cfe8cee8cce8cae8c8"
    "e8c6e8c4e8c2e8c1e8bfe8bde8bbe8b9e8b7e8b5e8b4e8b2e8b0e8aee8ace8aae8a9e8a7"
    "e8a5e8a3e8a1e89fe89ee89ce89ae898e896e895e893e891e88fe88de88ce88ae888e886"
    "e884e883e881e87fe87de87be87ae878e876e874e872e871e86fe86de86be86ae868e866"
    "e864e862e861e85fe85de85be85ae858e856e854e853e851e84fe84de84ce84ae848e846"
    "e845e843e841e83fe83ee83ce83ae838e837e835e833e831e830e82ee82ce82be829e827"
    "e825e824e822e820e81fe81de81be819e818e816e814e813e811e80fe80de80ce80ae808"
    "e807e805e803e802e800e7fee7fde7fbe7f9e7f7e7f6e7f4e7f2e7f1e7efe7ede7ece7ea"
    "e7e8e7e7e7e5e7e3e7e2e7e0e7dee7dde7dbe7d9e7d8e7d6e7d4e7d3e7d1e7d0e7cee7cc"
    "e7cbe7c9e7c7e7c6e7c4e7c2e7c1e7bfe7bee7bce7bae7b9e7b7e7b5e7b4e7b2e7b0e7af"
    "e7ade7ace7aae7a8e7a7e7a5e7a4e7a2e7a0e79fe79de79be79ae798e797e795e793e792"
    "e790e78fe78de78be78ae788e787e785e784e782e780e77fe77de77ce77ae778e777e775"
    "e774e772e771e76fe76de76ce76ae769e767e766e764e762e761e75fe75ee75ce75be759"
    "e758e756e754e753e751e750e74ee74de74be74ae748e747e745e744e742e740e73fe73d"
    "e73ce73ae739e737e736e734e733e731e730e72ee72de72be72ae728e727e725e723e722"
    "e720e71fe71de71ce71ae719e717e716e714e713e711e710e70ee70de70be70ae708e707"
    "e705e704e703e701e700e6fee6fde6fbe6fae6f8e6f7e6f5e6f4e6f2e6f1e6efe6eee6ec"
    "e6ebe6e9e6e8e6e6e6e5e6e4e6e2e6e1e6dfe6dee6dce6dbe6d9e6d8e6d6e6d5e6d3e6d2"
    "e6d1e6cfe6cee6cce6cbe6c9e6c8e6c6e6c5e6c4e6c2e6c1e6bfe6bee6bce6bbe6bae6b8"
    "e6b7e6b5e6b4e6b2e6b1e6b0e6aee6ade6abe6aae6a8e6a7e6a6e6a4e6a3e6a1e69fe69c"
    "e69ae697e694e691e68ee68ce689e686e683e680e67ee67be678e675e673e670e66de66a"
    "e667e665e662e65fe65de65ae657e654e652e64fe64ce64ae647e644e641e63fe63ce639"
    "e637e634e631e62fe62ce629e627e624e621e61fe61ce619e617e614e612e60fe60ce60a"
    "e607e605e602e5ffe5fde5fae5f8e5f5e5f2e5f0e5ede5ebe5e8e5e6e5e3e5e0e5dee5db"
    "e5d9e5d6e5d4e5d1e5cfe5cce5cae5c7e5c4e5c2e5bfe5bde5bae5b8e5b5e5b3e5b0e5ae"
    "e5abe5a9e5a7e5a4e5a2e59fe59de59ae598e595e593e590e58ee58be589e587e584e582"
    "e57fe57de57ae578e576e573e571e56ee56ce56ae567e565e562e560e55ee55be559e557"
    "e554e552e54fe54de54be548e546e544e541e53fe53de53ae538e536e533e531e52fe52c"
    "e52ae528e525e523e521e51ee51ce51ae518e515e513e511e50ee50ce50ae508e505e503"
    "e501e4ffe4fce4fae4f8e4f6e4f3e4f1e4efe4ede4eae4e8e4e6e4e4e4e1e4dfe4dde4db"
    "e4d9e4d6e4d4e4d2e4d0e4cee4cbe4c9e4c7e4c5e4c3e4c0e4bee4bce4bae4b8e4b6e4b3"
    "e4b1e4afe4ade4abe4a9e4a6e4a4e4a2e4a0e49ee49ce49ae497e495e493e491e48fe48d"
    "e48be489e486e484e482e480e47ee47ce47ae478e476e474e471e46fe46de46be469e467"
    "e465e463e461e45fe45de45be459e457e455e452e450e44ee44ce44ae448e446e444e442"
    "e440e43ee43ce43ae438e436e434e432e430e42ee42ce42ae428e426e424e422e420e41e"
    "e41ce41ae418e416e414e412e410e40ee40ce40ae408e406e404e402e400e3fee3fde3fb"
    "e3f9e3f7e3f5e3f3e3f1e3efe3ede3ebe3e9e3e7e3e5e3e3e3e1e3e0e3dee3dce3dae3d8"
    "e3d6e3d4e3d2e3d0e3cee3cce3cbe3c9e3c7e3c5e3c3e3c1e3bfe3bde3bce3bae3b8e3b6"
    "e3b4e3b2e3b0e3aee3ade3abe3a9e3a7e3a5e3a3e3a1e3a0e39ee39ce39ae398e396e395"
    "e393e391e38fe38de38be38ae388e386e384e382e381e37fe37de37be379e378e376e374"
    "e372e370e36fe36de36be369e367e366e364e362e360e35ee35de35be359e357e356e354"
    "e352e350e34fe34de34be349e348e346e344e342e341e33fe33de33be33ae338e336e334"
    "e333e331e32fe32ee32ce32ae328e327e325e323e322e320e31ee31ce31be319e317e316"
    "e314e312e311e30fe30de30be30ae308e306e305e303e301e300e2fee2fce2fbe2f9e2f7"
    "e2f6e2f4e2f2e2f1e2efe2ede2ece2eae2e8e2e7e2e5e2e3e2e2e2e0e2dfe2dde2dbe2da"
    "e2d8e2d6e2d5e2d3e2d1e2d0e2cee2cde2cbe2c9e2c8e2c6e2c5e2c3e2c1e2c0e2bee2bc"
    "e2bbe2b9e2b8e2b6e2b4e2b3e2b1e2b0e2aee2ace2abe2a9e2a8e2a6e2a5e2a3e2a1e2a0"
    "e29ee29de29be29ae298e296e295e293e292e290e28fe28de28be28ae288e287e285e284"
    "e282e281e27fe27ee27ce27ae279e277e276e274e273e271e270e26ee26de26be26ae268"
    "e267e265e263e262e260e25fe25de25ce25ae259e257e256e254e253e251e250e24ee24d"
    "e24be24ae248e247e245e244e242e241e23fe23ee23de23be23ae238e237e235e234e232"
    "e231e22fe22ee22ce22be229e228e226e225e224e222e221e21fe21ee21ce21be219e218"
    "e216e215e214e212e211e20fe20ee20ce20be20ae208e207e205e204e202e201e200e1fe"
    "e1fde1fbe1fae1f8e1f7e1f6e1f4e1f3e1f1e1f0e1efe1ede1ece1eae1e9e1e8e1e6e1e5"
    "e1e3e1e2e1e1e1dfe1dee1dce1dbe1dae1d8e1d7e1d5e1d4e1d3e1d1e1d0e1cfe1cde1cc"
    "e1cae1c9e1c8e1c6e1c5e1c4e1c2e1c1e1bfe1bee1bde1bbe1bae1b9e1b7e1b6e1b5e1b3"
    "e1b2e1b0e1afe1aee1ace1abe1aae1a8e1a7e1a6e1a4e1a3e1a2e1a0e19fe19ee19ce19b"
    "e19ae198e197e196e194e193e192e190e18fe18ee18ce18be18ae188e187e186e185e183"
    "e182e181e17fe17ee17de17be17ae179e177e176e175e174e172e171e170e16ee16de16c"
    "e16be169e168e167e165e164e163e162e160e15fe15ee15ce15be15ae159e157e156e155"
    "e153e152e151e150e14ee14de14ce14be149e148e147e146e144e143e142e141e13fe13e"
    "e13de13ce13ae139e138e137e135e134e133e132e130e12fe12ee12de12be12ae129e128"
    "e126e125e124e123e122e120e11fe11ee11de11be11ae119e118e117e115e114e113e112"
    "e110e10fe10ee10de10ce10ae109e108e107e106e104e103e102e101e100e0fee0fde0fc"
    "e0fbe0fae0f8e0f7e0f6e0f5e0f4e0f2e0f1e0f0e0efe0eee0ede0ebe0eae0e9e0e8e0e7"
    "e0e5e0e4e0e3e0e2e0e1e0e0e0dee0dde0dce0dbe0dae0d9e0d7e0d6e0d5e0d4e0d3e0d2"
    "e0d0e0cfe0cee0cde0cce0cbe0c9e0c8e0c7e0c6e0c5e0c4e0c3e0c1e0c0e0bfe0bee0bd"
    "e0bce0bbe0b9e0b8e0b7e0b6e0b5e0b4e0b3e0b1e0b0e0afe0aee0ade0ace0abe0a9e0a8"
    "e0a7e0a6e0a5e0a4e0a3e0a2e0a0e09fe09ee09de09ce09be09ae099e098e096e095e094"
    "e093e092e091e090e08fe08ee08ce08be08ae089e088e087e086e085e084e082e081e080"
    "e07fe07ee07de07ce07be07ae079e078e076e075e074e073e072e071e070e06fe06ee06d"
    "e06ce06be069e068e067e066e065e064e063e062e061e060e05fe05ee05de05be05ae059"
    "e058e057e056e055e054e053e052e051e050e04fe04ee04de04ce04ae049e048e047e046"
    "e045e044e043e042e041e040e03fe03ee03de03ce03be03ae039e038e037e036e034e033"
    "e032e031e030e02fe02ee02de02ce02be02ae029e028e027e026e025e024e023e022e021"
    "e020e01fe01ee01de01ce01be01ae019e018e017e016e015e014e013e012e011e010e00f"
    "e00ee00de00ce00be00ae009e008e007e006e005e004e003e002e001")

_POWF_LOG2 = (
    0x3ff661ec79f8f3be, 0xbfdefec65b963019, 0x3ff571ed4aaf883d, 0xbfdb0b6832d4fca4,
    0x3ff49539f0f010b0, 0xbfd7418b0a1fb77b, 0x3ff3c995b0b80385, 0xbfd39de91a6dcf7b,
    0x3ff30d190c8864a5, 0xbfd01d9bf3f2b631, 0x3ff25e227b0b8ea0, 0xbfc97c1d1b3b7af0,
    0x3ff1bb4a4a1a343f, 0xbfc2f9e393af3c9f, 0x3ff12358f08ae5ba, 0xbfb960cbbf788d5c,
    0x3ff0953f419900a7, 0xbfaa6f9db6475fce, 0x3ff0000000000000, 0x0000000000000000,
    0x3fee608cfd9a47ac, 0x3fb338ca9f24f53d, 0x3feca4b31f026aa0, 0x3fc476a9543891ba,
    0x3feb2036576afce6, 0x3fce840b4ac4e4d2, 0x3fe9c2d163a1aa2d, 0x3fd40645f0c6651c,
    0x3fe886e6037841ed, 0x3fd88e9c2c1b9ff8, 0x3fe767dcf5534862, 0x3fdce0a44eb17bcc,
    0x3fd27616c9496e0b, 0xbfd71969a075c67a, 0x3fdec70a6ca7badd, 0xbfe7154748bef6c8,
    0x3ff71547652ab82b,)

_EXP2F = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
    0x42e8000000000000, 0x3fac6af84b912394, 0x3fcebfce50fac4f3, 0x3fe62e42ff0c52d6,)
